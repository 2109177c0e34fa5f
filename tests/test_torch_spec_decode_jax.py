"""The port's speculative engine against the JAX package's, the exact
drafter (every layer), on the tiny float32 DALLE of test_torch_dalle.py
(fused block width 4, spec_k 3, max_batch 2), unquantized and int8
pages: with greedy sampling (top-k 1) the outcomes, tokens and the
``serve.spec.*`` drafted / accepted / rejected / fallbacks counters
equal JAX's (helper ``test_torch_spec_decode_engine.check_jax``)."""

import pytest
import torch

from dalle_pytorch_tpu_torch.testing import reset_registries
from test_torch_prefix_engine import QUANTS, jax_pages, models  # noqa: F401
from test_torch_spec_decode_engine import check_jax

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_registries():
    """Each test's engines count from zero in the port's registries."""
    reset_registries()
    yield
    reset_registries()


@pytest.mark.parametrize("kv_quant", QUANTS.values(), ids=QUANTS.keys())
def test_exact_drafter_matches_jax_engine(models, kv_quant):
    ours = check_jax(models, spec_k=3, kv_quant=kv_quant)
    assert ours._spec_accepted == ours._spec_drafted > 0
