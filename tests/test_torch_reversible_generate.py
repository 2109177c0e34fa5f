"""Generation outside the engine from test_torch_reversible_serve.py's
reversible DALLEs (rotary with token shift, and learned positions)
against the JAX package on the CPU, float32: greedy tokens of
``generate_image_tokens`` on the "4d", "flat" and "paged" caches
identical to JAX's, and other tokens from the same weights run
sequentially."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import sampling as jsampling
from dalle_pytorch_tpu_torch.models import sampling
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from test_torch_dalle import CONFIG, PAGE
from test_torch_generate import prompts
from test_torch_reversible_serve import jax_pages, models  # noqa: F401  (fixtures)

torch.set_num_threads(1)


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


def test_sequential_and_reversible_tokens_differ(models):
    """The same weights run sequentially give other tokens: the decode
    form's reversible wiring is what the matches above hold."""
    _, _, model = models
    text, _ = prompts(model)
    seq_model = DALLE(**{**CONFIG, "rotary_emb": model.rotary_emb}, device="cpu")
    seq_model.load_state_dict(model.state_dict())
    kw = dict(filter_thres=1.0, cache_format="flat", window_seg=0, page_size=PAGE)
    got = sampling.generate_image_tokens(model, torch.from_numpy(text), 0, **kw)
    other = sampling.generate_image_tokens(seq_model, torch.from_numpy(text), 0, **kw)
    assert not torch.equal(got, other)
