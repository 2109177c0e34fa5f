"""test_torch_clip_train.py's checks on the tiny CLIP of
test_torch_clip.py (text_seq_len 4: both sides attend densely), with the
key mask: the loss and every gradient against JAX's in float32, and in
bfloat16 compute on float32 parameters within ``BF16_GAP_FACTOR`` times
JAX's own gap, at test_torch_clip_train.py's tolerances; the similarity
without ``return_loss`` unchanged."""

import pytest
import torch

import test_torch_clip_train as clip_train

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    return clip_train.clip_case("dense")


def test_text_encoder_takes_the_named_route(case):
    clip_train.test_text_encoder_takes_the_named_route(case)


def test_loss_and_every_gradient_match_jax_float32(case):
    clip_train.test_loss_and_every_gradient_match_jax_float32(case)


def test_loss_and_every_gradient_match_jax_bf16(case):
    clip_train.check_loss_and_every_gradient_bf16(case)


def test_similarity_unchanged_by_return_loss(case):
    clip_train.test_similarity_unchanged_by_return_loss(case)
