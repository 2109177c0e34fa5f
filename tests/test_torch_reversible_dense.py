"""test_torch_reversible.py's checks against JAX on the dense route: a
reversible DALLE with learned positions, depth 3, n 24 (no flash block),
float32, dropout 0: the route, logits without a gradient to atol 1e-4,
the loss and every gradient against ``jax.grad``, and 3 clipped-Adam
steps against JAX's ``make_train_step``, at test_torch_reversible.py's
tolerances."""

import pytest
import torch

import test_torch_reversible as rev

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    return rev.reversible_case("dense")


def test_routes_are_the_ones_named(case):
    rev.test_routes_are_the_ones_named(case)


def test_logits_without_a_gradient_match(case):
    rev.test_logits_without_a_gradient_match(case)


def test_loss_and_every_gradient_match_jax(case):
    rev.test_loss_and_every_gradient_match_jax(case)


def test_three_adam_steps_match_jax(case):
    rev.test_three_adam_steps_match_jax(case)


def test_function_runs_only_with_a_gradient(case, monkeypatch):
    rev.test_function_runs_only_with_a_gradient(case, monkeypatch)
