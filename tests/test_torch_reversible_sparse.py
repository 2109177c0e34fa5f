"""Reversible execution on the sparse configuration against the JAX
package on the CPU, float32: test_torch_sparse_train.py's DALLE (layers
cycling "full", "axial_row", "axial_col", "conv_like", text 64 + a 24 x 24
grid, n 640, token shift, rotary) at depth 4 with ``reversible=True``,
JAX with ``DALLE_TPU_SPARSE_KERNEL=1`` so that its axial_row and
conv_like layers take the pair grid (interpret mode) as the port's do.
At test_torch_reversible.py's tolerances: the routes and the loss and
every gradient against ``jax.grad`` (3 clipped-Adam steps against JAX's
``make_train_step`` in test_torch_reversible_sparse_steps.py)."""

import pytest
import torch

import test_torch_reversible as rev
from test_torch_sparse_train import CONFIG

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _pair_grid_in_jax(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_SPARSE_KERNEL", "1")


@pytest.fixture(scope="module")
def case():
    config = {**CONFIG, "reversible": True}
    return (config, *rev.jax_params(config))


def test_pair_grid_layers_route_as_jax(case):
    config, _, params = case
    model = rev.port(params, config)
    routes = [b.fn.fn.fn.uses_block_sparse(model.total_seq_len)
              for b in model.transformer.attn_blocks]
    assert routes == [False, True, False, True] and model.transformer.reversible


def test_loss_and_every_gradient_match_jax(case):
    config, jmodel, params = case
    rev.check_loss_and_gradients(jmodel, params, rev.port(params, config),
                                 *rev.batch(config, 4))

