"""test_torch_clip_train.py's bfloat16 check on its packed CLIP cut to
one text and one image layer (text_seq_len 128, 2 heads of 64: JAX's
packed kernel in interpret mode, the port's plain version, non-causal
with the key mask): bfloat16 compute
on float32 parameters against JAX's ``CLIP(dtype=jnp.bfloat16)``, every
gradient, the similarity logits, the loss's terms and the two scalars
within ``BF16_GAP_FACTOR`` times JAX's own bf16-to-float32 gap, as
test_torch_clip_train.py states."""

import pytest
import torch

import test_torch_clip_train as clip_train
from test_torch_clip import converted, inputs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    # one text and one image layer: the same route at half the
    # interpret-mode kernel's cost on the JAX side
    config = {**clip_train.CONFIGS["packed"], "text_enc_depth": 1, "visual_enc_depth": 1}
    _, params, _ = converted(config, seed=3)
    return ("packed", config, params, *inputs(config, b=4, seed=5))


def test_loss_and_every_gradient_match_jax_bf16(case):
    clip_train.check_loss_and_every_gradient_bf16(case)
