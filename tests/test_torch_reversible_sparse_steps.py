"""test_torch_reversible_sparse.py's reversible sparse DALLE (depth 4
cycling "full", "axial_row", "axial_col", "conv_like", n 640; JAX with
``DALLE_TPU_SPARSE_KERNEL=1``), float32: params and Adam moments after 3
clipped-Adam steps against JAX's ``make_train_step``, at
test_torch_reversible.py's tolerances (the update's relative L2 error
within 1e-3 and each moment's within 1e-5 per tensor, losses to rtol
1e-5)."""

import pytest
import torch

import test_torch_reversible as rev
from test_torch_reversible_sparse import case  # noqa: F401  (the fixture)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _pair_grid_in_jax(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_SPARSE_KERNEL", "1")


def test_three_adam_steps_match_jax(case):  # noqa: F811
    config, jmodel, params = case
    rev.check_three_steps(jmodel, params, rev.port(params, config),
                          [rev.batch(config, 10 + i) for i in range(3)])
